"""Serving DF-GAN: ``Sampler.generate_stages`` of the port on an
``InferState`` whose ``GanConfig`` names the DF-GAN generator, one call a
batch of captions with the batch's noise (and an eps, which DF-GAN does
not read) passed in: AttnGAN's serving entry and graph path
(``drivers/serve.py``), whose driver this one extends.

Set-up builds the port's ``InferState`` and loads the seeded weights (no
statistics: DF-GAN has no BatchNorm). Then one call of each caption
length the pool holds warms every shape up, twice. A port whose
``GanConfig`` has no ``generator`` cannot build the configuration and
fails before anything else.

The check runs once the window has closed: a sample of the pool's entries
drawn from the seed, with a longest caption in it, whose first call in the
window kept its outputs, is recomputed by the fp32 reference
(``reference/dfgan.py``, TF32 off) as blocks of rows, and the images are
compared by the worst image's mean gap; non-finite values fail. There
are no attention maps. The control is the port's own int8 tier
(``Int8Sampler``), calibrated on the first batch it serves.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench import traffic as tr
from perfbench.counts import dfgan as counts
from perfbench.counts.flops import model_flops, on_meta
from perfbench.drivers import serve
from perfbench.reference import fp32
from perfbench.reference.dfgan import Serving
from perfbench.weights import seeded_state


def gan_config(cfg: dict):
    """The port's GanConfig of the configuration; raises where the port
    has no DF-GAN generator."""
    from attngan_torch.core.config import GanConfig

    try:
        return GanConfig(
            generator=cfg["generator"], gf_dim=cfg["gf_dim"],
            emb_dim=cfg["emb_dim"], z_dim=cfg["z_dim"],
            cond_dim=cfg["cond_dim"], seq_len=cfg["seq_len"],
            compute_dtype=cfg["compute_dtype"])
    except TypeError as e:
        raise RuntimeError(f"this port cannot build {cfg['name']}: its "
                           f"GanConfig has no generator family ({e})") from e


class Driver(serve.Driver):
    """One serving call a window call; ``variant`` "control" serves through
    the port's int8 tier."""

    def __init__(self, cell: dict, cfg: dict, seed: int, device,
                 variant: str = "program"):
        gan = gan_config(cfg)
        from attngan_torch.infer.quantize import Int8Sampler
        from attngan_torch.infer.sampler import InferState, Sampler

        self.cfg, self.traffic, self.device = cfg, cell["mix"], device
        self.limits = cell["check"]
        self.rows = self.traffic["rows"]
        w_seed, p_seed, s_seed = tr.sub_seeds(seed, 3)
        self.state_dict = seeded_state(on_meta(Serving(cfg, cfg["vocab"])),
                                       w_seed, device)
        self.pool = tr.make_pool(self.traffic, cfg, p_seed, device)
        state = InferState(gan, cfg["vocab"])
        state.load_state_dict(self.state_dict, strict=True)
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
             for key in ("tokens", "lengths", "noise")}
        images = []
        with torch.no_grad(), fp32():
            for r0 in range(0, len(b["tokens"]), serve.REFERENCE_ROWS):
                rows = slice(r0, r0 + serve.REFERENCE_ROWS)
                images.append(ref(b["tokens"][rows], b["lengths"][rows],
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
        lengths = torch.full((self.rows,), self.cfg["seq_len"])
        words = float(self.pool["lengths"].float().mean()) * self.rows
        with torch.no_grad():
            return model_flops(lambda: ref(meta["tokens"], lengths,
                                           meta["noise"]),
                               [ref.rnn], words)

    def bounds_per_call(self) -> Dict[str, float]:
        return {"dfblock": sum(counts.dfblock_bound_s(*s) for s in
                               counts.serve_df_layers(self.rows,
                                                      self.cfg["gf_dim"]))}
