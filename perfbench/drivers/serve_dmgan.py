"""Serving DM-GAN: ``Sampler.generate_stages`` of the port on an
``InferState`` whose ``GanConfig`` names the DM-GAN generator, one call a
batch of captions with the batch's noise and eps passed in: AttnGAN's
serving entry and graph path (``drivers/serve.py``), whose driver this one
extends.

Set-up builds the port's ``InferState`` first, so that a port without
the DM-GAN generator fails before anything else; then it loads the seeded
weights with the eval BatchNorm statistics that the reference
(``reference/dmgan.py``) calibrated in one train-mode forward at a batch
of 64 captions, as ``serve.py`` does. Then one call of each caption
length the pool holds warms every shape up, twice.

The check runs once the window has closed: a sample of the pool's entries
drawn from the seed, with a longest caption in it, whose first call in the
window kept its outputs, is recomputed by the fp32 reference (TF32 off) as
blocks of 64 rows, and each stage's images and both memory maps are
compared: the worst image's mean gap and the maps' widest gap; non-finite
values fail. The control is the port's own int8 tier (``Int8Sampler``),
calibrated on the first batch it serves.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench import traffic as tr
from perfbench.counts import dmgan as counts
from perfbench.counts import kernels
from perfbench.counts.flops import model_flops, on_meta
from perfbench.drivers import serve
from perfbench.reference import fp32
from perfbench.reference.dmgan import Serving, word_mask
from perfbench.weights import seeded_state


def gan_config(cfg: dict):
    """The port's GanConfig of the configuration."""
    from attngan_torch.core.config import GanConfig

    return GanConfig(
        generator=cfg["generator"], gf_dim=cfg["gf_dim"],
        df_dim=cfg["df_dim"], emb_dim=cfg["emb_dim"],
        cond_dim=cfg["cond_dim"], z_dim=cfg["z_dim"], seq_len=cfg["seq_len"],
        num_stages=cfg["num_stages"], compute_dtype=cfg["compute_dtype"])


def calibrated_state(cfg: dict, w_seed: int, c_seed: int, device
                     ) -> Dict[str, torch.Tensor]:
    """Seeded weights and the BN statistics of one train-mode reference
    forward at ``serve.CALIBRATION_ROWS`` captions (momentum 1)."""
    ref = Serving(cfg, cfg["vocab"]).to(device)
    ref.load_state_dict(seeded_state(ref, w_seed, device), strict=True)
    pool = tr.make_pool({"pool": 1, "rows": serve.CALIBRATION_ROWS,
                         "words": [1, cfg["seq_len"]]}, cfg, c_seed, device)
    b = tr.batch(pool, 0)
    for m in ref.modules():
        if hasattr(m, "running_var"):
            m.momentum = 1.0
    ref.generator.train()
    with torch.no_grad(), fp32():
        words, sent = ref.rnn(b["tokens"], b["lengths"])
        ref.generator(b["noise"], sent, words,
                      word_mask(b["lengths"].to(device), cfg["seq_len"]),
                      b["eps"])
    return {k: v.detach().clone() for k, v in ref.state_dict().items()}


class Driver(serve.Driver):
    """One serving call a window call; ``variant`` "control" serves through
    the port's int8 tier."""

    def __init__(self, cell: dict, cfg: dict, seed: int, device,
                 variant: str = "program"):
        from attngan_torch.infer.quantize import Int8Sampler
        from attngan_torch.infer.sampler import InferState, Sampler

        state = InferState(gan_config(cfg), cfg["vocab"])
        self.cfg, self.traffic, self.device = cfg, cell["mix"], device
        self.limits = cell["check"]
        self.rows = self.traffic["rows"]
        w_seed, c_seed, p_seed, s_seed = tr.sub_seeds(seed, 4)
        self.state_dict = calibrated_state(cfg, w_seed, c_seed, device)
        self.pool = tr.make_pool(self.traffic, cfg, p_seed, device)
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
             for key in ("tokens", "lengths", "noise", "eps")}
        images, attns = [], []
        with torch.no_grad():
            for r0 in range(0, len(b["tokens"]), serve.REFERENCE_ROWS):
                i, a = ref(*(b[k][r0:r0 + serve.REFERENCE_ROWS] for k in
                             ("tokens", "lengths", "noise", "eps")))
                images.append(i)
                attns.append(a)
        images = [torch.cat(s) for s in zip(*images)]
        attns = [torch.cat(s) for s in zip(*attns)]
        got_images = [torch.cat([self.kept[k][0][s] for k in self.sample])
                      for s in range(len(images))]
        got_attns = [torch.cat([self.kept[k][1][s] for k in self.sample])
                     for s in range(len(attns))]
        # an image's mean gap, so that one altered image shows; the maps'
        # widest gap
        worst = {"image_mean_abs": max(
            float((g.float() - w).abs().flatten(1).mean(1).max())
            for g, w in zip(got_images, images)),
            "attn_max_abs": max(float((g.float() - w).abs().max())
                                for g, w in zip(got_attns, attns))}
        finite = all(bool(torch.isfinite(g).all())
                     for g in got_images + got_attns)
        out = [{"name": k, "value": v, "limit": self.limits.get(k)}
               for k, v in worst.items()]
        out.append({"name": "nonfinite", "value": 0.0 if finite else 1.0,
                    "limit": 0.0})
        return out

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
                                           meta["noise"], meta["eps"]),
                               [ref.rnn], words)

    def bounds_per_call(self) -> Dict[str, float]:
        gf, stages = self.cfg["gf_dim"], self.cfg["num_stages"]
        return {"memread": sum(counts.memread_bound_s(*s) for s in
                               counts.serve_memory_reads(
                                   self.rows, gf, self.cfg["seq_len"],
                                   stages)),
                "upblock": sum(kernels.upblock_bound_s(*s) for s in
                               kernels.serve_upblocks(self.rows, gf, stages))}
