"""Serving GALIP: ``Sampler.generate_stages`` of the port on an
``InferState`` whose ``GanConfig`` names the GALIP generator, one call a
batch of captions in CLIP's layout with the batch's noise (and an eps,
which GALIP does not read) passed in: AttnGAN's serving entry and graph
path (``drivers/serve.py``), whose driver this one extends, as
``serve_dfgan.py`` does.

Set-up builds the port's ``GanConfig`` first, so that a port without
GALIP fails before anything else; then the seeded weights (weights.py's
draw, with every LayerNorm's scale and shift redrawn as BatchNorm's are,
1 + 0.1 n and 0.1 n, from the same numbers: weights.py would seed them as
biases, 0.05 n, and a LayerNorm of gain ~0 passes almost nothing on).
The pool is traffic.py's, turned into CLIP's layout here: each caption's
ids moved into 1..vocab - 3 (49,405 for CLIP), SOT (vocab - 2) before
them, EOT (vocab - 1) after, 0 to the context's end, so that the argmax
pools at EOT. Then one call of each caption length the pool holds warms
every shape up, twice.

The check runs once the window has closed: a sample of the pool's entries
drawn from the seed, with a longest caption in it, whose first call in
the window kept its outputs, is recomputed by the fp32 reference
(``reference/galip.py``, TF32 off) as blocks of 64 rows, and the images
are compared by the worst image's mean gap; non-finite values fail. The
control is the port's own int8 tier (``Int8Sampler``), calibrated on the
first batch it serves. Three fault variants, which ``perfbench/limits.py``
reads, show what the image check sees: "no_bridge" leaves the bridge's
0.1 map out of the port (the ViT path), "no_causal" runs the text
tower's 12 layers without their causal mask, and "no_sentence" zeroes
the sentence embedding the generator reads (the text path).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench import traffic as tr
from perfbench.counts import galip as counts
from perfbench.counts.flops import model_flops, on_meta
from perfbench.drivers import serve
from perfbench.reference import fp32
from perfbench.reference.galip import LayerNorm, Serving
from perfbench.weights import seeded_state

CLIP_FIELDS = ("clip_width", "clip_heads", "vit_width", "vit_heads")


def gan_config(cfg: dict):
    """The port's GanConfig of the configuration; raises where the port
    has no GALIP sizes."""
    from attngan_torch.core.config import GanConfig

    try:
        return GanConfig(
            generator=cfg["generator"], gf_dim=cfg["gf_dim"],
            emb_dim=cfg["emb_dim"], z_dim=cfg["z_dim"],
            cond_dim=cfg["cond_dim"], seq_len=cfg["seq_len"],
            compute_dtype=cfg["compute_dtype"],
            **{k: cfg[k] for k in CLIP_FIELDS})
    except TypeError as e:
        raise RuntimeError(f"this port cannot build {cfg['name']}: its "
                           f"GanConfig has no CLIP sizes ({e})") from e


def galip_state(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """weights.py's seeded state of the reference, each LayerNorm's scale
    redrawn 1 + 0.1 n and its shift 0.1 n from the same n."""
    ref = on_meta(Serving(cfg, cfg["vocab"]))
    state = seeded_state(ref, seed, device)
    for name, m in ref.named_modules():
        if isinstance(m, LayerNorm):
            n_w = state[f"{name}.weight"] / 0.05    # weights.py's 0.05 n
            n_b = state[f"{name}.bias"] / 0.05
            state[f"{name}.weight"] = 1.0 + 0.1 * n_w
            state[f"{name}.bias"] = 0.1 * n_b
    return state


def clip_pool(pool: dict, vocab: int) -> dict:
    """traffic.py's pool with its tokens in CLIP's layout (P, B, context):
    SOT, each caption's ids in 1..vocab - 3, EOT, then 0; the lengths
    stay the captions' ids."""
    tokens, lengths = pool["tokens"], pool["lengths"]
    ctx = tokens.shape[-1]
    if int(lengths.max()) + 2 > ctx:
        raise ValueError(f"captions of {int(lengths.max())} ids do not fit "
                         f"CLIP's context of {ctx} with SOT and EOT")
    n = lengths.to(tokens.device)[..., None]
    steps = torch.arange(ctx, device=tokens.device)
    ids = torch.zeros_like(tokens)
    ids[..., 1:] = tokens[..., :-1] % (vocab - 3) + 1
    out = torch.where((steps >= 1) & (steps <= n), ids, 0)
    out = torch.where(steps == 0, vocab - 2, out)
    out = torch.where(steps == n + 1, vocab - 1, out)
    return dict(pool, tokens=out)


def leave_out_bridge(state) -> None:
    """A fault variant: the port's mapper returns zeros, so the bridge
    adds no 0.1 map to its features."""
    mapper = state.generator.mapping.CLIP_ViT
    mapper.forward = lambda fuse, prompts: torch.zeros_like(
        fuse, dtype=torch.float32)


def drop_causal_mask(state) -> None:
    """A fault variant: each of the text tower's layers attends over the
    whole context, EOT's row to the padding after it too."""
    for block in state.text_encoder.transformer.resblocks:
        block.forward = (lambda x, causal=True, run=block.forward:
                         run(x, causal=False))


def zero_sentence(state) -> None:
    """A fault variant: the text tower's sentence embedding comes out as
    zeros."""
    run = state.text_encoder.forward
    state.text_encoder.forward = lambda tokens, lengths=None: (
        None, torch.zeros_like(run(tokens, lengths)[1]))


VARIANTS = {"no_bridge": leave_out_bridge, "no_causal": drop_causal_mask,
            "no_sentence": zero_sentence}


class Driver(serve.Driver):
    """One serving call a window call; ``variant`` "control" serves through
    the port's int8 tier, one of ``VARIANTS`` with that fault."""

    def __init__(self, cell: dict, cfg: dict, seed: int, device,
                 variant: str = "program"):
        gan = gan_config(cfg)
        from attngan_torch.infer.quantize import Int8Sampler
        from attngan_torch.infer.sampler import InferState, Sampler

        self.cfg, self.traffic, self.device = cfg, cell["mix"], device
        self.limits = cell["check"]
        self.rows = self.traffic["rows"]
        w_seed, p_seed, s_seed = tr.sub_seeds(seed, 3)
        self.state_dict = galip_state(cfg, w_seed, device)
        self.pool = clip_pool(tr.make_pool(self.traffic, cfg, p_seed, device),
                              cfg["vocab"])
        state = InferState(gan, cfg["vocab"])
        state.load_state_dict(self.state_dict, strict=True)
        if variant in VARIANTS:
            VARIANTS[variant](state)
        make = Int8Sampler if variant == "control" else Sampler
        self.sampler = make(state, device=device)
        self.sample = self._draw_sample(s_seed)
        self.kept: Dict[int, tuple] = {}
        self.calls_to_check = self.pool["tokens"].shape[0]
        lengths = self.pool["lengths"]
        warm = sorted({int(lengths[k].max()): k for k in
                       range(len(lengths))}.values())
        for k in warm + warm:            # each length served, twice
            self._serve(k)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def check(self, fault=None) -> List[dict]:
        """[{name, value, limit}] of the sample against the reference."""
        missing = [k for k in self.sample if k not in self.kept]
        if missing:
            raise RuntimeError(f"pool entries {missing} were never served")
        ref = Serving(self.cfg, self.cfg["vocab"]).to(self.device)
        ref.load_state_dict(self.state_dict, strict=True)
        ref.eval()
        b = {key: torch.cat([tr.batch(self.pool, k)[key]
                             for k in self.sample])
             for key in ("tokens", "noise")}
        images = []
        with torch.no_grad(), fp32():
            for r0 in range(0, len(b["tokens"]), serve.REFERENCE_ROWS):
                rows = slice(r0, r0 + serve.REFERENCE_ROWS)
                images.append(ref(b["tokens"][rows], None,
                                  b["noise"][rows])[0][0])
        want = torch.cat(images)
        got = torch.cat([self.kept[k][0][0] for k in self.sample])
        # an image's mean gap, so that one altered image shows
        worst = float((got.float() - want).abs().flatten(1).mean(1).max())
        finite = bool(torch.isfinite(got).all())
        return [{"name": "image_mean_abs", "value": worst,
                 "limit": self.limits.get("image_mean_abs")},
                {"name": "nonfinite", "value": 0.0 if finite else 1.0,
                 "limit": 0.0}]

    # ---- work counts ----

    def flops_per_call(self) -> float:
        ref = on_meta(Serving(self.cfg, self.cfg["vocab"]))
        ref.eval()
        b = tr.batch(self.pool, 0)
        meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in b.items()}
        with torch.no_grad():
            return model_flops(lambda: ref(meta["tokens"], None,
                                           meta["noise"]), [], 0)

    def bounds_per_call(self) -> Dict[str, float]:
        return {"clip_attn": sum(counts.clip_attn_bound_s(*s) for s in
                                 counts.serve_attention(self.rows,
                                                        self.cfg)),
                "dfblock": sum(counts.dfblock_bound_s(*s) for s in
                               counts.serve_df_layers(self.rows, self.cfg))}
