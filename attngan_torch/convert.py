"""Weight bridge: a JAX ``InferState``, ``DamsmState`` or ``GanState`` -> the
port.

The input is a flat ``{path: np.ndarray}`` dict keyed by the flax path
joined with "/" under the three subtrees sampling touches, e.g.
``gen_params/gen1/UpBlock_0/kernel``, ``gen_stats/gen2/ResBlock_0/
TorchBatchNorm_1/var``, ``rnn_params/w_ih_fwd`` (what ``np.savez`` of a
flattened JAX InferState holds). Layouts:

  conv kernel HWIO                -> weight OIHW
  Dense kernel (in, out)          -> Linear weight (out, in)
  word_proj kernel (1, 1, E, gf)  -> Linear weight (gf, E)
  TorchBatchNorm scale / bias     -> weight / bias
  batch_stats mean / var          -> running_mean / running_var
  BiLSTM w_ih_* (E, 4H), w_hh_* (H, 4H), b_* (4H)
                                  -> weight_ih_l0[_reverse] (4H, E),
                                     weight_hh_l0[_reverse] (4H, H),
                                     bias_ih = b, bias_hh = 0
                                     (gate order is already i, f, g, o)

Coverage is strict: every JAX leaf is consumed exactly once and every port
parameter and buffer is filled; a missing or extra key raises.

A flattened ``DamsmState`` (the DAMSM pretraining state) is read by
``load_damsm_flat`` the same way, under the subtrees
``rnn_params`` (the BiLSTM, as above), ``cnn_head_params``
(``emb_features/kernel`` (1, 1, F, D) -> the 1x1 conv's (D, F, 1, 1);
``emb_cnn_code`` Dense -> Linear), ``cnn_trunk_params/trunk/...`` (conv
kernels HWIO -> OIHW, BN scale / bias -> weight / bias, a flax module path
``Mixed_5b/branch1x1/conv`` -> ``Mixed_5b.branch1x1.conv``), ``cnn_stats/
trunk/...`` (mean / var -> running_mean / running_var), ``opt_state`` and
``step``. optax's Adam state flattens with sequence indices as numbers and
named fields by name: ``opt_state/0/count``, ``opt_state/0/mu/rnn/w_ih_fwd``,
``opt_state/0/nu/cnn_heads/emb_cnn_code/bias``; mu and nu take their
parameter's layout and become torch Adam's ``exp_avg`` / ``exp_avg_sq``,
the count its ``step``. The state's PRNG key has no counterpart (the port
draws dropout from a torch.Generator) and is not part of the input.

A flattened ``GanState`` is read by ``load_gan_flat``: ``gen_params`` /
``gen_stats`` as an InferState's, ``disc_params/<res>/...`` and
``disc_stats/<res>/...`` by ``_disc_key`` (flax's ``DownBlock_1/Conv_0``
-> the port's ``down.1.conv``), ``gen_opt_state/0/...`` and
``disc_opt_states/<res>/0/...`` as the DamsmState's ``opt_state``,
``rnn_params``, ``cnn_params/{trunk/...,emb_features,emb_cnn_code}`` and
``cnn_stats/trunk/...`` (the whole frozen image encoder) and ``step``.
Its PRNG key is not part of the input either.
tools/convert_torch_weights.py is the trunk mapping in the other direction.

``python -m attngan_torch.convert STATE.npz --out DIR`` (``write_checkpoint``)
reads the ``.npz`` that the repository root's ``export_jax_state.py``
writes from an orbax checkpoint (the flat dict above plus a ``__meta__``
entry: the kind, the JAX config, the vocabulary size, the step, the epoch)
and writes a port checkpoint directory, ``DIR/step_*/<part>.pt`` with
``config.json`` and ``progress.json``: an InferState's ``rnn.pt`` and
``gen.pt``, which ``cli.infer --checkpoint DIR`` serves, or a whole
DamsmState or GanState, which ``cli.train --damsm-checkpoint DIR`` and
``--resume`` read. A converted state has no ``generator.pt`` (JAX's PRNG
key has no counterpart): the torch generator restarts from the training
CLI's ``--seed`` at the first ``--resume``.

A pretrained trunk (``--pretrained-cnn``) is read from the torchvision
Inception-v3 ``.pth`` itself by ``load_pretrained_trunk``: the port's trunk
has torchvision's keys, so only the classifier heads and the BN counters
are dropped. The JAX CLI reads the flax msgpack that
tools/convert_torch_weights.py makes from the same file. A torchvision
vgg19_bn ``.pth`` loads the same way (``load_torchvision_vgg19_bn``: the
``features.*`` entries without the BN counters).

The JAX package's DFCVAE, AutoEncoder and VGG19BNFeatures variables,
flattened with "/" under ``params`` and ``batch_stats``, load through
``load_vae_flat`` and ``load_vgg_flat``. A flax ``ConvTranspose`` kernel
(kH, kW, I, O) becomes torch's (I, O, kH, kW) FLIPPED in space: flax
applies it unflipped (models/vae.py::ConvTransposeSame).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
from typing import Dict, Mapping

import numpy as np
import torch

_SUBTREES = ("rnn_params", "gen_params", "gen_stats")
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}


def _generator_key(path: str) -> str:
    """'gen2/ResBlock_1/TorchBatchNorm_0/scale' -> 'gen2.res.1.bn1.weight'."""
    parts = path.split("/")
    out = []
    for i, seg in enumerate(parts[:-1]):
        parent = parts[i - 1] if i else ""
        if seg == "CondAugment_0":
            out.append("ca")
        elif seg == "Dense_0":
            out.append("fc")
        elif seg == "word_proj" or re.fullmatch(r"gen\d|img_out\d", seg):
            out.append(seg)
        elif m := re.fullmatch(r"UpBlock_(\d)", seg):
            out.append(f"up.{m[1]}" if parts[0] == "gen1" else "up")
        elif m := re.fullmatch(r"ResBlock_(\d)", seg):
            out.append(f"res.{m[1]}")
        elif m := re.fullmatch(r"(Conv|TorchBatchNorm)_(\d)", seg):
            if parent.startswith("ResBlock_"):
                out.append(("conv" if m[1] == "Conv" else "bn")
                           + str(int(m[2]) + 1))
            elif parent.startswith("UpBlock_") or parent.startswith("img_out"):
                out.append("conv" if m[1] == "Conv" else "bn")
            else:
                out.append("bn")
        else:
            raise KeyError(f"unknown generator path segment {seg!r} in {path}")
    if parts[-1] not in _LEAVES:
        raise KeyError(f"unknown leaf {parts[-1]!r} in {path}")
    # an UpBlock's own kernel is its conv's weight
    if parts[-1] == "kernel" and parts[-2].startswith("UpBlock_"):
        out.append("conv")
    return ".".join(out + [_LEAVES[parts[-1]]])


def _generator_value(path: str, a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    if path.endswith("word_proj/kernel"):
        return t.reshape(t.shape[-2], t.shape[-1]).t().contiguous()
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1).contiguous()      # HWIO -> OIHW
    if t.dim() == 2:
        return t.t().contiguous()                      # (in, out) -> (out, in)
    return t


def _rnn_state(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    def get(name):
        return torch.from_numpy(np.array(flat[name], dtype=np.float32))

    sd = {"embedding.weight": get("embedding")}
    for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
        sd[f"lstm.weight_ih_l0{suffix}"] = get(f"w_ih_{direction}").t().contiguous()
        sd[f"lstm.weight_hh_l0{suffix}"] = get(f"w_hh_{direction}").t().contiguous()
        b = get(f"b_{direction}")
        sd[f"lstm.bias_ih_l0{suffix}"] = b
        sd[f"lstm.bias_hh_l0{suffix}"] = torch.zeros_like(b)
    return sd


_RNN_LEAVES = {"embedding", "w_ih_fwd", "w_hh_fwd", "b_fwd", "w_ih_bwd",
               "w_hh_bwd", "b_bwd"}


def convert_flat(flat: Mapping[str, np.ndarray]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Flat JAX InferState -> {"rnn": state_dict, "generator": state_dict}."""
    rnn_flat, gen_sd = {}, {}
    for key, value in flat.items():
        tree, _, path = key.partition("/")
        if tree not in _SUBTREES or not path:
            raise KeyError(f"unexpected key {key!r}: not under {_SUBTREES}")
        if tree == "rnn_params":
            if path not in _RNN_LEAVES:
                raise KeyError(f"unexpected BiLSTM leaf {key!r}")
            rnn_flat[path] = value
            continue
        port_key = _generator_key(path)
        if port_key in gen_sd:
            raise KeyError(f"{key!r} maps onto {port_key!r} twice")
        gen_sd[port_key] = _generator_value(path, value)
    missing = _RNN_LEAVES - set(rnn_flat)
    if missing:
        raise KeyError(f"missing BiLSTM leaves: {sorted(missing)}")
    return {"rnn": _rnn_state(rnn_flat), "generator": gen_sd}


def load_flat(flat: Mapping[str, np.ndarray], rnn: torch.nn.Module,
              generator: torch.nn.Module) -> None:
    """Fill ``rnn`` and ``generator`` in place; raises on any key that is
    missing or left over on either side, or a shape that disagrees."""
    sd = convert_flat(flat)
    rnn.load_state_dict(sd["rnn"], strict=True)
    generator.load_state_dict(sd["generator"], strict=True)


# ---------------------------------------------------------------- DamsmState

_DAMSM_TREES = ("rnn_params", "cnn_head_params", "cnn_trunk_params",
                "cnn_stats", "opt_state", "step")
_RNN_KEYS = {"embedding": "embedding.weight"}
for _d, _sfx in (("fwd", ""), ("bwd", "_reverse")):
    _RNN_KEYS.update({f"w_ih_{_d}": f"lstm.weight_ih_l0{_sfx}",
                      f"w_hh_{_d}": f"lstm.weight_hh_l0{_sfx}",
                      f"b_{_d}": f"lstm.bias_ih_l0{_sfx}"})
_HEAD_KEYS = {"emb_features/kernel": "emb_features.weight",
              "emb_cnn_code/kernel": "emb_cnn_code.weight",
              "emb_cnn_code/bias": "emb_cnn_code.bias"}
_TRUNK_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _layout(a: np.ndarray, transpose: bool = True) -> torch.Tensor:
    """A flax leaf in the torch layout: HWIO -> OIHW, (in, out) -> (out, in)."""
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1).contiguous()
    if t.dim() == 2 and transpose:
        return t.t().contiguous()
    return t


def _rnn_key(leaf: str) -> str:
    if leaf not in _RNN_KEYS:
        raise KeyError(f"unexpected BiLSTM leaf {leaf!r}")
    return _RNN_KEYS[leaf]


def _head_key(path: str) -> str:
    if path not in _HEAD_KEYS:
        raise KeyError(f"unexpected head leaf {path!r}")
    return _HEAD_KEYS[path]


def _module_key(path: str, leaves: Mapping[str, str]) -> str:
    scope, _, leaf = path.rpartition("/")
    if not scope or leaf not in leaves:
        raise KeyError(f"unexpected conv / BN leaf {path!r}")
    return f"{scope.replace('/', '.')}.{leaves[leaf]}"


def block_state_dict(params: Mapping[str, np.ndarray],
                     stats: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The flax variables of a trunk or of one of its blocks, each tree
    flattened with "/", -> the matching port module's state_dict."""
    sd = {_module_key(k, _TRUNK_LEAVES): _layout(v) for k, v in params.items()}
    for k, v in stats.items():
        sd[_module_key(k, _STAT_LEAVES)] = _layout(v)
    return sd


def _put(sd: dict, key: str, value, src: str) -> None:
    if key in sd:
        raise KeyError(f"{src!r} maps onto {key!r} twice")
    sd[key] = value


def _add_hh_biases(rnn: dict) -> None:
    """The JAX BiLSTM has one bias a direction: bias_hh is zero."""
    for name, b in list(rnn.items()):
        if ".bias_ih_" in name:
            rnn[name.replace("bias_ih", "bias_hh")] = torch.zeros_like(b)


def _adam_slot(adam: dict, name: str, moment: str, value, src: str) -> None:
    """One optax moment leaf (``moment`` "mu" or "nu") into adam[name] as
    torch Adam's exp_avg / exp_avg_sq."""
    _put(adam.setdefault(name, {}),
         "exp_avg" if moment == "mu" else "exp_avg_sq", value, src)


def _load_adam(optimizer: torch.optim.Optimizer,
               params: Mapping[str, torch.nn.Parameter], adam: dict,
               count: int) -> None:
    """Fill torch Adam's state of ``params`` (name -> parameter) from
    {name: {"exp_avg", "exp_avg_sq"}} and optax's count; raises unless the
    moments cover the parameters exactly, in their shapes."""
    if set(adam) != set(params):
        raise KeyError(f"Adam state does not cover the trainable parameters:"
                       f" missing {sorted(set(params) - set(adam))}, "
                       f"extra {sorted(set(adam) - set(params))}")
    for name, p in params.items():
        slot = adam[name]
        if set(slot) != {"exp_avg", "exp_avg_sq"}:
            raise KeyError(f"Adam state of {name} lacks mu or nu")
        for k, v in slot.items():
            if v.shape != p.shape:
                raise RuntimeError(f"Adam {k} of {name}: {tuple(v.shape)} vs "
                                   f"{tuple(p.shape)}")
        optimizer.state[p] = {"step": torch.tensor(float(count)),
                              **{k: v.to(p.device) for k, v in slot.items()}}


def convert_damsm_flat(flat: Mapping[str, np.ndarray]) -> dict:
    """Flat JAX DamsmState -> {"rnn": state_dict, "cnn": state_dict,
    "adam": {port parameter name: {"exp_avg", "exp_avg_sq"}}, "count",
    "step"}; port parameter names as DamsmState.trainable() gives them."""
    rnn, cnn, adam, trunk, stats = {}, {}, {}, {}, {}
    count = step = None
    for key, value in flat.items():
        tree, _, path = key.partition("/")
        if tree not in _DAMSM_TREES:
            raise KeyError(f"unexpected key {key!r}: not under {_DAMSM_TREES}")
        if tree == "step":
            step = int(np.asarray(value))
        elif tree == "rnn_params":
            _put(rnn, _rnn_key(path), _layout(value, path != "embedding"), key)
        elif tree == "cnn_head_params":
            _put(cnn, _head_key(path), _layout(value), key)
        elif tree in ("cnn_trunk_params", "cnn_stats"):
            if not path.startswith("trunk/"):
                raise KeyError(f"unexpected trunk leaf {key!r}")
            (trunk if tree == "cnn_trunk_params" else stats)[path] = value
        elif path == "0/count":
            count = int(np.asarray(value))
        else:
            idx, moment, sub, rest = (path.split("/", 3) + ["", "", ""])[:4]
            if idx != "0" or moment not in ("mu", "nu") or not rest:
                raise KeyError(f"unexpected optimizer leaf {key!r}")
            if sub == "rnn":
                name = "rnn." + _rnn_key(rest)
                value = _layout(value, rest != "embedding")
            elif sub == "cnn_heads":
                name = "cnn." + _head_key(rest)
                value = _layout(value)
            else:
                raise KeyError(f"unexpected optimizer leaf {key!r}")
            _adam_slot(adam, name, moment, value, key)
    for k, v in block_state_dict(trunk, stats).items():
        _put(cnn, k, v, k)
    _add_hh_biases(rnn)
    if count is None or step is None:
        raise KeyError("missing opt_state/0/count or step")
    return {"rnn": rnn, "cnn": cnn, "adam": adam, "count": count,
            "step": step}


def load_damsm_flat(flat: Mapping[str, np.ndarray], state) -> None:
    """Fill a ``train.damsm_trainer.DamsmState`` in place (weights, trunk
    statistics, Adam moments and count, step); raises on any key missing or
    left over on either side, or a shape that disagrees."""
    sd = convert_damsm_flat(flat)
    state.rnn.load_state_dict(sd["rnn"], strict=True)
    state.cnn.load_state_dict(sd["cnn"], strict=True)
    _load_adam(state.optimizer, dict(state.trainable()), sd["adam"],
               sd["count"])
    state.step = sd["step"]
    state.frozen_trunk = None    # the trunk changed: refold at first use


# ----------------------------------------------------------------- GanState

_GAN_TREES = ("gen_params", "gen_stats", "disc_params", "disc_stats",
              "gen_opt_state", "disc_opt_states", "rnn_params", "cnn_params",
              "cnn_stats", "step")


def _disc_key(path: str) -> str:
    """'DownBlock_1/TorchBatchNorm_0/scale' -> 'down.1.bn.weight' (the port's
    models/discriminators.py); 'ImageEncoder16x_0/Conv_2/kernel' ->
    'encoder.conv.2.weight'; the head 'Conv_0/bias' -> 'head.bias'."""
    *scope, leaf = path.split("/")
    if leaf in _LEAVES and scope:
        if scope == ["Conv_0"]:
            return f"head.{_LEAVES[leaf]}"
        block = re.fullmatch(r"(ImageEncoder16x|DownBlock|Block3x3LeakyRelu)_"
                             r"(\d)", scope[0]) if len(scope) == 2 else None
        layer = re.fullmatch(r"(Conv|TorchBatchNorm)_(\d)", scope[-1])
        if block and layer:
            kind = "conv" if layer[1] == "Conv" else "bn"
            if block[1] == "ImageEncoder16x" and block[2] == "0":
                return f"encoder.{kind}.{layer[2]}.{_LEAVES[leaf]}"
            if block[1] != "ImageEncoder16x" and layer[2] == "0":
                group = "down" if block[1] == "DownBlock" else "squeeze"
                return f"{group}.{block[2]}.{kind}.{_LEAVES[leaf]}"
    raise KeyError(f"unknown discriminator path {path!r}")


def convert_gan_flat(flat: Mapping[str, np.ndarray]) -> dict:
    """Flat JAX GanState -> {"generator": state_dict, "discs": {res:
    state_dict}, "rnn": state_dict, "cnn": state_dict, "adam": {"gen" or
    res: {parameter name: {"exp_avg", "exp_avg_sq"}}}, "count": {"gen" or
    res: optax count}, "step"}. ``res`` is the resolution as a string, the
    key of ``GanState.discs``."""
    gen, rnn, cnn, trunk, stats = {}, {}, {}, {}, {}
    discs, adam, count = {}, {}, {}
    step = None
    for key, value in flat.items():
        tree, _, path = key.partition("/")
        if tree not in _GAN_TREES:
            raise KeyError(f"unexpected key {key!r}: not under {_GAN_TREES}")
        if tree == "step":
            step = int(np.asarray(value))
        elif tree in ("gen_params", "gen_stats"):
            _put(gen, _generator_key(path), _generator_value(path, value), key)
        elif tree in ("disc_params", "disc_stats"):
            res, _, path = path.partition("/")
            _put(discs.setdefault(res, {}), _disc_key(path), _layout(value),
                 key)
        elif tree == "rnn_params":
            _put(rnn, _rnn_key(path), _layout(value, path != "embedding"), key)
        elif tree in ("cnn_params", "cnn_stats"):
            if path.startswith("trunk/"):
                (trunk if tree == "cnn_params" else stats)[path] = value
            elif tree == "cnn_params":
                _put(cnn, _head_key(path), _layout(value), key)
            else:
                raise KeyError(f"unexpected trunk leaf {key!r}")
        else:
            who = "gen"
            if tree == "disc_opt_states":
                who, _, path = path.partition("/")
            idx, moment, rest = (path.split("/", 2) + ["", ""])[:3]
            if idx != "0" or not moment:
                raise KeyError(f"unexpected optimizer leaf {key!r}")
            if moment == "count" and not rest:
                _put(count, who, int(np.asarray(value)), key)
                continue
            if moment not in ("mu", "nu") or not rest:
                raise KeyError(f"unexpected optimizer leaf {key!r}")
            if who == "gen":
                name, value = _generator_key(rest), _generator_value(rest,
                                                                     value)
            else:
                name, value = _disc_key(rest), _layout(value)
            _adam_slot(adam.setdefault(who, {}), name, moment, value, key)
    for k, v in block_state_dict(trunk, stats).items():
        _put(cnn, k, v, k)
    _add_hh_biases(rnn)
    if step is None:
        raise KeyError("missing step")
    return {"generator": gen, "discs": discs, "rnn": rnn, "cnn": cnn,
            "adam": adam, "count": count, "step": step}


def load_gan_flat(flat: Mapping[str, np.ndarray], state) -> None:
    """Fill a ``train.gan_trainer.GanState`` in place: generator and
    discriminator weights and BN statistics, the four Adam states (moments
    and counts), the frozen BiLSTM and image encoder, the step. Raises on
    any key missing or left over on either side, or a shape that
    disagrees."""
    sd = convert_gan_flat(flat)
    if set(sd["discs"]) != set(state.discs):
        raise KeyError(f"discriminators {sorted(sd['discs'])} in the input, "
                       f"{sorted(state.discs)} in the state")
    state.gen.load_state_dict(sd["generator"], strict=True)
    for res, disc in state.discs.items():
        disc.load_state_dict(sd["discs"][res], strict=True)
    state.rnn.load_state_dict(sd["rnn"], strict=True)
    state.cnn.load_state_dict(sd["cnn"], strict=True)
    optimizers = {"gen": (state.gen_optimizer, state.gen),
                  **{res: (state.disc_optimizers[res], disc)
                     for res, disc in state.discs.items()}}
    if set(sd["count"]) != set(optimizers):
        raise KeyError(f"optimizer counts for {sorted(sd['count'])}, "
                       f"expected {sorted(optimizers)}")
    for who, (optimizer, module) in optimizers.items():
        _load_adam(optimizer, dict(module.named_parameters()),
                   sd["adam"].get(who, {}), sd["count"][who])
    state.step = sd["step"]
    state.frozen_trunk = None    # the trunk may have changed: refold


# ------------------------------------------------------------ ResNet18

_RESNET_LEAVES = {"params": {"kernel": "weight", "scale": "weight",
                             "bias": "bias"},
                  "batch_stats": {"mean": "running_mean",
                                  "var": "running_var"}}
_RESNET_SCOPES = {"downsample_conv": "downsample.0",
                  "downsample_bn": "downsample.1"}


def _resnet_key(key: str) -> str:
    """'params/layer2_0/downsample_bn/scale' -> 'layer2.0.downsample.1.weight'
    (models/resnet.py's torchvision keys)."""
    tree, *scopes, leaf = key.split("/")
    leaves = _RESNET_LEAVES.get(tree, {})
    if not scopes or leaf not in leaves:
        raise KeyError(f"unexpected ResNet18 leaf {key!r}")
    parts = [re.sub(r"^(layer\d)_(\d)$", r"\1.\2", s) for s in scopes]
    parts = [_RESNET_SCOPES.get(p, p) for p in parts]
    return ".".join(parts + [leaves[leaf]])


def convert_resnet_flat(flat: Mapping[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """The JAX ``ImageEmbedder``'s variables, flattened with "/" under
    ``params`` and ``batch_stats`` -> a models/resnet.py ResNet18
    state_dict (conv kernels HWIO -> OIHW; each BN's
    ``num_batches_tracked`` 0)."""
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        _put(sd, _resnet_key(key), _layout(value), key)
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key.replace("running_mean", "num_batches_tracked")] = \
            torch.tensor(0)
    return sd


def load_resnet_flat(flat: Mapping[str, np.ndarray], model: torch.nn.Module
                     ) -> None:
    """Fill a ResNet18 in place; raises on any key missing or left over on
    either side, or a shape that disagrees."""
    model.load_state_dict(convert_resnet_flat(flat), strict=True)


# ------------------------------------------------- DFCVAE, AutoEncoder, VGG

def _vae_value(scope: str, leaf: str, value) -> torch.Tensor:
    t = torch.from_numpy(np.array(value, dtype=np.float32))
    if scope.startswith("ConvTranspose_") and leaf == "kernel":
        # flax's (kH, kW, I, O), applied unflipped -> torch's (I, O, kH, kW)
        return t.permute(2, 3, 0, 1).flip(2, 3).contiguous()
    return _layout(value)


def _vae_key(key: str, depth: int) -> str:
    """'params/TorchBatchNorm_9/scale' -> 'dec_bn.1.weight' (a DFCVAE of
    ``depth`` hidden widths); 'batch_stats/DownBlockLeakyReLU_3/
    TorchBatchNorm_0/mean' -> 'down.3.bn.running_mean' (an AutoEncoder)."""
    tree, *scopes, leaf = key.split("/")
    leaves = _RESNET_LEAVES.get(tree, {})
    if not scopes or leaf not in leaves:
        raise KeyError(f"unexpected VAE leaf {key!r}")
    parts = []
    for scope in scopes:
        name, _, index = scope.rpartition("_")
        if not index.isdigit():
            parts.append(scope)                 # fc_mu, fc1, decoder_input
            continue
        i = int(index)
        if name in ("DownBlockLeakyReLU", "UpBlockReLU"):
            parts.append(f"{'down' if name[0] == 'D' else 'up'}.{i}")
        elif name == "Conv" and len(scopes) > 1:
            parts.append("conv")
        elif name == "TorchBatchNorm" and len(scopes) > 1:
            parts.append("bn")
        elif name == "Conv":
            parts.append(f"encoder.{i}" if i < depth else "out_conv")
        elif name == "TorchBatchNorm":
            parts.append(f"enc_bn.{i}" if i < depth else f"dec_bn.{i - depth}")
        elif name == "ConvTranspose":
            parts.append(f"decoder.{i}")
        else:
            raise KeyError(f"unexpected VAE scope {scope!r} in {key!r}")
    return ".".join(parts + [leaves[leaf]])


def convert_vae_flat(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``DFCVAE``'s or ``AutoEncoder``'s variables, flattened with
    "/" under ``params`` and ``batch_stats``, -> the models/vae.py module's
    state_dict: conv kernels HWIO -> OIHW, a ConvTranspose kernel HWIO ->
    (I, O, kH, kW) flipped (flax does not flip it), Dense (in, out) ->
    (out, in), BN scale / bias / mean / var -> weight / bias /
    running_mean / running_var."""
    depth = len({k.split("/")[1] for k in flat
                 if k.split("/")[1].startswith("ConvTranspose_")})
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        scope, leaf = key.split("/")[1], key.rsplit("/", 1)[1]
        _put(sd, _vae_key(key, depth), _vae_value(scope, leaf, value), key)
    return sd


def load_vae_flat(flat: Mapping[str, np.ndarray], model: torch.nn.Module
                  ) -> None:
    """Fill a DFCVAE or AutoEncoder in place; raises on any key missing or
    left over on either side, or a shape that disagrees."""
    model.load_state_dict(convert_vae_flat(flat), strict=True)


def convert_vgg_flat(flat: Mapping[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
    """The JAX ``VGG19BNFeatures``' variables, flattened with "/" under
    ``params`` and ``batch_stats`` ('params/features_14/kernel') -> the
    port's torchvision keys ('features.14.weight')."""
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        tree, scope, leaf = key.split("/")
        leaves = _RESNET_LEAVES.get(tree, {})
        m = re.fullmatch(r"features_(\d+)", scope)
        if m is None or leaf not in leaves:
            raise KeyError(f"unexpected VGG leaf {key!r}")
        _put(sd, f"features.{m[1]}.{leaves[leaf]}", _layout(value), key)
    return sd


def load_vgg_flat(flat: Mapping[str, np.ndarray], model: torch.nn.Module
                  ) -> None:
    """Fill a VGG19BNFeatures in place, strictly."""
    model.load_state_dict(convert_vgg_flat(flat), strict=True)


def torchvision_vgg_state_dict(state_dict: Mapping[str, torch.Tensor]
                               ) -> Dict[str, torch.Tensor]:
    """A torchvision vgg19_bn ``state_dict`` -> models/vgg.py's
    VGG19BNFeatures': the ``features.*`` entries without the BN counters
    (the classifier is not part of the tap walk, VAE.py:143-162)."""
    return {k: v for k, v in state_dict.items()
            if k.startswith("features.")
            and not k.endswith(".num_batches_tracked")}


def load_torchvision_vgg19_bn(path: str) -> Dict[str, torch.Tensor]:
    """The features state_dict of the torchvision vgg19_bn ``.pth`` at
    ``path`` (weights only), for ``VGG19BNFeatures.load_state_dict(...,
    strict=True)``."""
    return torchvision_vgg_state_dict(
        torch.load(path, map_location="cpu", weights_only=True))


# ------------------------------------------------- torchvision Inception-v3

_TORCHVISION_HEADS = ("AuxLogits.", "fc.")


def torchvision_trunk_state_dict(state_dict: Mapping[str, torch.Tensor]
                                 ) -> Dict[str, torch.Tensor]:
    """A torchvision Inception-v3 ``state_dict`` -> the port trunk's
    (models/cnn_encoder.py::InceptionV3Trunk): ``AuxLogits.*``, ``fc.*``
    and every BN's ``num_batches_tracked`` dropped, every other entry kept
    as it is. A strict ``load_state_dict`` then refuses a key that is
    missing, left over or of another shape."""
    return {k: v for k, v in state_dict.items()
            if not k.startswith(_TORCHVISION_HEADS)
            and not k.endswith(".num_batches_tracked")}


def load_pretrained_trunk(path: str) -> Dict[str, torch.Tensor]:
    """The trunk state_dict of the torchvision Inception-v3 ``.pth`` at
    ``path`` (a ``torch.load``-able state_dict, weights only), for
    ``DamsmTrainer.init_state(pretrained_cnn=)``."""
    return torchvision_trunk_state_dict(
        torch.load(path, map_location="cpu", weights_only=True))


# ------------------------------------------- an exported JAX state -> a dir

@dataclasses.dataclass
class _ServingParts:
    """The two parts of a GAN checkpoint that serving reads."""

    rnn: torch.nn.Module
    gen: torch.nn.Module


def _port_config(cls, recorded: Mapping[str, object]):
    """The port's ``cls`` with the fields a JAX config recorded; the
    kernel switches (``fused_*``) keep the port's defaults: they choose
    how the same function runs, and the port's run its kernels."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in recorded.items()
                  if k in names and not k.startswith("fused")})


def write_checkpoint(npz_path: str, out: str) -> str:
    """The port checkpoint directory ``out`` of an ``export_jax_state.py``
    file, without the state's generator; returns the step's path."""
    from attngan_torch.core.config import DamsmConfig, GanConfig
    from attngan_torch.train.checkpoint import save_checkpoint

    with np.load(npz_path) as f:
        meta = json.loads(str(f["__meta__"]))
        flat = {k: f[k] for k in f.files if k != "__meta__"}
    kind, vocab = meta["kind"], meta["vocab_size"]
    if kind == "infer":
        from attngan_torch.infer.sampler import InferState

        cfg = _port_config(GanConfig, meta["config"])
        infer = InferState(cfg, vocab)
        load_flat(flat, infer.rnn, infer.generator)
        state, step = _ServingParts(infer.rnn, infer.generator), meta["step"]
    elif kind == "damsm":
        from attngan_torch.train.damsm_trainer import DamsmTrainer

        cfg = _port_config(DamsmConfig, meta["config"])
        state = DamsmTrainer(cfg, vocab, seq_len=1,
                             device="cpu").init_state(0)
        load_damsm_flat(flat, state)
        step = state.step
    elif kind == "gan":
        from attngan_torch.train.gan_trainer import GanTrainer

        cfg = _port_config(GanConfig, meta["config"])
        state = GanTrainer(cfg, vocab, device="cpu").init_state(0)
        load_gan_flat(flat, state)
        step = state.step
    else:
        raise ValueError(f"{npz_path}: unknown state kind {kind!r}")
    path = save_checkpoint(out, state, step, cfg, epoch=meta.get("epoch", 0))
    if kind != "infer":
        os.remove(os.path.join(path, "generator.pt"))
    return path


def main(argv=None) -> str:
    p = argparse.ArgumentParser(
        prog="python -m attngan_torch.convert",
        description="Turn an export_jax_state.py .npz into a port "
                    "checkpoint directory (DIR/step_*/<part>.pt).")
    p.add_argument("npz", help="the file export_jax_state.py wrote")
    p.add_argument("--out", required=True, help="the checkpoint directory")
    args = p.parse_args(argv)
    path = write_checkpoint(args.npz, args.out)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
