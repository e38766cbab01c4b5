"""A torchvision ``.pth`` state_dict -> the strict state_dict that the
port's module loads: the port's form of tools/convert_torch_weights.py.

The JAX package converts torchvision's layout into flax's msgpack. The
port's trunks carry torchvision's keys and layouts, so its converter only
drops what its module does not hold, then checks the result with a strict
``load_state_dict`` before writing it with ``torch.save``:

* ``inception``: Inception-v3 minus ``AuxLogits.*``, ``fc.*`` and the BN
  counters -> models/cnn_encoder.py::InceptionV3Trunk
  (``convert.torchvision_trunk_state_dict``, which ``--pretrained-cnn``
  runs on the ``.pth`` itself);
* ``resnet18``: minus ``fc.*`` -> models/resnet.py::ResNet18 (its BNs are
  torch's, counters included): ``ImageEmbedder(variables=torch.load(out))``;
* ``vgg19_bn``: ``features.*`` minus the BN counters ->
  models/vgg.py::VGG19BNFeatures (``convert.torchvision_vgg_state_dict``).

    python -m attngan_torch.tools.convert_torch_weights \\
        {inception,resnet18,vgg19_bn} in.pth out.pt
"""

from __future__ import annotations

import argparse

import torch


def _module(kind: str) -> torch.nn.Module:
    if kind == "inception":
        from attngan_torch.models.cnn_encoder import InceptionV3Trunk

        return InceptionV3Trunk()
    if kind == "resnet18":
        from attngan_torch.models.resnet import ResNet18

        return ResNet18()
    from attngan_torch.models.vgg import VGG19BNFeatures

    return VGG19BNFeatures()


def convert(kind: str, state_dict: dict) -> dict:
    """The port module's state_dict of a torchvision one; raises where a
    strict load refuses it."""
    from attngan_torch.convert import (
        torchvision_trunk_state_dict,
        torchvision_vgg_state_dict,
    )

    if kind == "inception":
        sd = torchvision_trunk_state_dict(state_dict)
    elif kind == "resnet18":
        sd = {k: v for k, v in state_dict.items() if not k.startswith("fc.")}
    else:
        sd = torchvision_vgg_state_dict(state_dict)
    with torch.device("meta"):
        module = _module(kind)
    module.load_state_dict(sd, strict=True, assign=True)
    return sd


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("kind", choices=("inception", "resnet18", "vgg19_bn"))
    p.add_argument("src", help="torchvision state_dict (.pth)")
    p.add_argument("dst", help="output state_dict (.pt)")
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    state_dict = torch.load(args.src, map_location="cpu", weights_only=True)
    torch.save(convert(args.kind, state_dict), args.dst)
    print(f"wrote {args.dst}")
    return args.dst


if __name__ == "__main__":
    main()
