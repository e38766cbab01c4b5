"""Batched text -> image inference: port of attngan_tpu/infer/sampler.py.

Tokens -> BiLSTM (fp32) -> word mask -> Generator (eval BatchNorm) ->
denormalize. The noise and the reparametrization eps can be injected (the
JAX package draws them with jax.random, which no torch generator
reproduces); otherwise they come from an explicit ``torch.Generator``.
``GanConfig.generator`` = "dmgan" serves DM-GAN's generator
(models/dmgan.py) on the same path: AttnGAN's stages and outputs, each
attention map a memory stage's addressing weights; "dfgan" serves
DF-GAN's (models/dfgan.py): one 256^2 stage, no attention maps, eps drawn
or taken and not read.

Data parallel (``Sampler(mesh=)``, JAX's ``Sampler(mesh=)``): every rank
is given the whole batch's tokens, draws the whole batch's noise and eps,
samples its own rows, and the images are gathered (``gather``) so that
rank 0 can write them.

On one CUDA device a call runs as a CUDA graph, one per input shape
(``Sampler.replayable`` says when): the text encoder (its K9 form, which
reads the lengths on the device; models/rnn_encoder.py), the word mask and
the generator. A shape's first call runs eagerly, which builds the kernels
and warms cuDNN; its second captures the three on static buffers of
(tokens, lengths, noise, eps), keyed by their shapes and dtypes, so that
the lengths are data and one graph serves every mix of them; from then on
a call copies its inputs into the buffers and replays the graph: the host
launches once instead of some 300 times, and never waits for the device.
Host data bound for the card goes through pinned memory with
``non_blocking`` (``core.runtime.to_device``), so the host can run calls
ahead of the device. The graphs share one memory pool and replay in turn
on the caller's stream; each call's outputs are copied out of the pool
(``denormalize``, the attention maps cloned) before the next replay can
overwrite them. The weights are read where they lie: ``load_state_dict``
in place reaches the next replay, and a text encoder or generator moved
elsewhere (``.to``) drops every graph. The kernel wrappers' launch
counters count what the host launches: an eager call's kernels and a
capture's, none of a replay's (``replays`` counts those). A shape whose
capture raises runs eagerly from then on, with one warning. Elsewhere (the
CPU, a mesh, train mode, grad on, an int8 interceptor) every call runs
eagerly.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn as nn

from attngan_torch.core.config import SHAPE_FIELDS, GanConfig, replace
from attngan_torch.core.runtime import resolve_device, to_device
from attngan_torch.data.dataset import word_mask
from attngan_torch.models.dfgan import DFGenerator
from attngan_torch.models.dmgan import DMGenerator
from attngan_torch.models.generator import Generator
from attngan_torch.models.rnn_encoder import BiLSTMEncoder
from attngan_torch.ops import int8
from attngan_torch.parallel.mesh import Mesh, all_gather_rows, shard_rows
from attngan_torch.utils.timing import span


def denormalize(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1]."""
    return torch.clamp(images * 0.5 + 0.5, 0.0, 1.0)


# the generator families, by GanConfig.generator
GENERATORS = {"attngan": Generator, "dmgan": DMGenerator,
              "dfgan": DFGenerator}


def build_generator(cfg: GanConfig) -> nn.Module:
    """The generator of ``cfg.generator``'s family, built from ``cfg``."""
    if cfg.generator not in GENERATORS:
        raise ValueError(f"generator must be one of {tuple(GENERATORS)}; "
                         f"got {cfg.generator!r}")
    return GENERATORS[cfg.generator].from_config(cfg)


class InferState(nn.Module):
    """What sampling touches: the text encoder and the generator (of the
    family ``cfg.generator`` names)."""

    def __init__(self, cfg: GanConfig, vocab_size: int):
        super().__init__()
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.rnn = BiLSTMEncoder(vocab_size, hidden_dim=cfg.emb_dim)
        self.generator = build_generator(cfg)


def save_infer_state(path: str, state: InferState) -> None:
    """torch.save of the weights with the shape fields that built them."""
    shapes = {k: getattr(state.cfg, k) for k in SHAPE_FIELDS}
    torch.save({"shapes": shapes, "vocab_size": state.vocab_size,
                "state_dict": state.state_dict()}, path)


def load_infer_state(path: str, cfg: Optional[GanConfig] = None,
                     device: str | torch.device | None = None) -> InferState:
    """Rebuild an InferState from ``save_infer_state``'s file. The file's
    shape fields override ``cfg``'s; its other fields (compute dtype, kernel
    switches) are ``cfg``'s. A file that records no generator family was
    written before there were two, and holds AttnGAN's."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    cfg = replace(cfg or GanConfig(),
                  **{"generator": "attngan", **blob["shapes"]})
    state = InferState(cfg, blob["vocab_size"])
    state.load_state_dict(blob["state_dict"], strict=True)
    return state.to(resolve_device(device))


class _Graph(NamedTuple):
    """A captured call: the static buffers it reads (tokens, lengths,
    noise, eps) and the outputs it writes."""

    graph: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]
    fakes: List[torch.Tensor]
    attns: List[torch.Tensor]


_WARM = "warm"      # a shape seen once, eagerly: the next call captures
_EAGER = "eager"    # a shape whose capture raised


class Sampler:
    """Serves an InferState on one device (the GPU unless asked otherwise),
    or this rank's rows of each batch on a mesh of ranks.

    ``captures``, ``replays`` and ``eager_calls`` count the calls by
    path."""

    def __init__(self, state: InferState,
                 device: str | torch.device | None = None,
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.state = state.to(self.device).eval()
        self.cfg = state.cfg
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._graphs: Dict[tuple, Union[_Graph, str]] = {}
        self._pool = None
        self._ends: Tuple[torch.Tensor, ...] = ()   # first, last parameters
        self._end_ptrs: Tuple[int, ...] = ()
        self.captures = self.replays = self.eager_calls = 0

    def replayable(self) -> bool:
        """Whether a call may run as a CUDA graph: on one CUDA device, the
        text encoder and the generator in eval mode, with grad off and no
        int8 interceptor."""
        return (self.device.type == "cuda" and self.mesh is None
                and not self.state.generator.training
                and not self.state.rnn.training
                and not torch.is_grad_enabled() and not int8.active())

    def _call(self, *inputs: torch.Tensor
              ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(fakes, attns) of the text encoder, word mask and generator on
        (tokens, lengths, noise, eps), the first two possibly on the host:
        replayed, captured, or eager."""
        if not self.replayable():
            return self._eager(inputs)
        self._drop_moved_graphs()
        key = tuple((t.shape, t.dtype) for t in inputs)
        entry = self._graphs.get(key)
        if entry is None:
            self._graphs[key] = _WARM
            return self._eager(inputs)
        if entry is _WARM:
            entry = self._graphs[key] = self._capture(key, inputs)
        if entry is _EAGER:
            return self._eager(inputs)
        with span("attngan.text_encoder"):
            for static, t in zip(entry.inputs[:2], inputs[:2]):
                to_device(t, self.device, out=static)
        with span("attngan.generator"):
            for static, t in zip(entry.inputs[2:], inputs[2:]):
                to_device(t, self.device, out=static)
            with span("attngan.replay"):
                entry.graph.replay()
            self.replays += 1
            return entry.fakes, [a.clone() for a in entry.attns]

    def _forward(self, tokens, lengths, noise, eps):
        """The call itself: text encoder, word mask, ``_generator``."""
        with span("attngan.text_encoder"):
            tokens = to_device(tokens, self.device)
            lengths = to_device(lengths, self.device)
            word_embs, sent_embs = self.state.rnn(tokens, lengths)
            mask = word_mask(lengths, tokens.shape[1])
        return self._generator(to_device(noise, self.device), sent_embs,
                               word_embs, mask, to_device(eps, self.device))

    def _generator(self, noise, sent_embs, word_embs, mask, eps
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(fakes, attns) of the generator on its inputs."""
        fakes, attns, _, _ = self.state.generator(noise, sent_embs,
                                                  word_embs, mask, eps=eps)
        return fakes, attns

    def _eager(self, inputs):
        self.eager_calls += 1
        return self._forward(*inputs)

    def _capture(self, key, inputs) -> Union[_Graph, str]:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static = tuple(to_device(t, self.device).clone() for t in inputs)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                fakes, attns = self._forward(*static)
        except RuntimeError as e:
            warnings.warn(f"no CUDA graph of the sampler's call at {key}, "
                          f"which runs eagerly from now on: {e}")
            return _EAGER
        self.captures += 1
        return _Graph(graph, static, fakes, attns)

    def _drop_moved_graphs(self) -> None:
        """Forget every graph once the text encoder or the generator has
        moved (``.to``, ``.cuda``): the graphs read the old addresses.
        Reads the first and the last parameter of each, which a move of the
        module changes; a ``.data =`` on one weight between them goes
        unseen."""
        if (self._ends and tuple(t.data_ptr() for t in self._ends)
                == self._end_ptrs):
            return
        self._graphs.clear()
        ends = []
        for module in (self.state.rnn, self.state.generator):
            params = list(module.parameters())
            ends += [params[0], params[-1]]
        self._ends = tuple(ends)
        self._end_ptrs = tuple(t.data_ptr() for t in self._ends)

    @torch.no_grad()
    def generate_stages(
        self, tokens, lengths, noise: Optional[torch.Tensor] = None,
        eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None, gather: bool = True,
    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """([per-stage (B,R,R,3) in [0,1]], [per-attention-stage (B,L,h,w)]).
        ``tokens`` and ``lengths`` may lie on the host (tensors, arrays or
        lists) or on the device. On a mesh ``tokens``, ``lengths`` and the
        given ``noise`` / ``eps`` are the whole batch's; the outputs are
        too, or this rank's rows only where ``gather`` is False."""
        with span("attngan.serve"):
            tokens, lengths = torch.as_tensor(tokens), torch.as_tensor(lengths)
            n = tokens.shape[0]
            if noise is None:
                noise = torch.randn((n, self.cfg.z_dim), generator=generator,
                                    device=self.device)
            if eps is None:     # the draw CondAugment would make next
                eps = torch.randn((n, self.cfg.cond_dim), generator=generator,
                                  device=self.device)
            fakes, attns = self._call(*(shard_rows(t, self.mesh)
                                        for t in (tokens, lengths, noise,
                                                  eps)))
            images = [denormalize(f) for f in fakes]
            if gather and self.mesh is not None:
                images = [all_gather_rows(x, self.mesh) for x in images]
                attns = [all_gather_rows(a, self.mesh) for a in attns]
            return images, attns

    def generate_from_tokens(self, tokens, lengths, noise=None, eps=None,
                             generator=None, gather: bool = True
                             ) -> torch.Tensor:
        """(B, 256, 256, 3) in [0, 1] (the last stage)."""
        return self.generate_stages(tokens, lengths, noise, eps, generator,
                                    gather)[0][-1]
