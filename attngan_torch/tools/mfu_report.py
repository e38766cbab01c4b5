"""MFU report for the three main paths: port of tools/mfu_report.py.

For each of the serving sampler, the DAMSM pretrain step and the 3-stage
GAN step (the configs' defaults unless the flags shrink them): count the
model FLOPs of one call on the plain path (``utils/mfu.py::model_flops``:
the same objects built with every ``fused_*`` switch off, so that each
product is an aten op the counter sees, the BiLSTM by formula), time the
call on the kernel path over >= 3 windows, each fenced by
``torch.cuda.synchronize()``, and print one JSON line a path: achieved
TFLOP/s and the share of the card's peak (None off the H100).

    python -m attngan_torch.tools.mfu_report [sampler] [damsm] [gan]
    python -m attngan_torch.tools.mfu_report sampler --sampler-batch 64

On the CPU (``--device cpu``, with the tiny flags) the lines carry no MFU:
a CPU has no entry in the peak table.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import numpy as np
import torch

PATHS = ("sampler", "damsm", "gan")
WINDOWS, VOCAB, SEED = 3, 1000, 0        # as the JAX tool has them


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("paths", nargs="*", help=f"of {PATHS}; default: all")
    p.add_argument("--device", default=None, help="default: the GPU")
    p.add_argument("--sampler-batch", type=int, default=512)
    p.add_argument("--damsm-batch", type=int, default=0,
                   help="0 = DamsmConfig's batch_size")
    p.add_argument("--gan-batch", type=int, default=0,
                   help="0 = GanConfig's batch_size")
    p.add_argument("--iters", type=int, default=0,
                   help="calls a window; 0 = 20 (sampler, GAN), 30 (DAMSM)")
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--gf-dim", type=int, default=32)
    p.add_argument("--df-dim", type=int, default=64)
    p.add_argument("--emb-dim", type=int, default=256)
    p.add_argument("--num-stages", type=int, default=3)
    p.add_argument("--image-encoder", default="inception_v3")
    args = p.parse_args(argv)
    unknown = set(args.paths) - set(PATHS)
    if unknown:
        p.error(f"unknown paths {sorted(unknown)}; choose from {PATHS}")
    args.paths = args.paths or list(PATHS)
    return args


def plain(cfg):
    """``cfg`` with every kernel switch (``fused_*``) off."""
    return dataclasses.replace(cfg, **{
        f.name: False for f in dataclasses.fields(cfg)
        if f.name.startswith("fused_")})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tag(cfg) -> str:
    return {"bfloat16": "bf16", "float32": "fp32"}.get(cfg.compute_dtype,
                                                      cfg.compute_dtype)


def report(name: str, make, cfg, unit_per_call: str, iters: int,
           device: torch.device) -> dict:
    """``make(cfg) -> (call, modules)``: FLOPs of one call built from
    ``plain(cfg)``, seconds a call (median over the windows) of one built
    from ``cfg``."""
    from attngan_torch.utils.mfu import mfu_report, model_flops

    call, modules = make(plain(cfg))
    flops, _ = model_flops(call, modules=modules)
    del call, modules
    call, _ = make(cfg)
    call()                                          # warm-up and builds
    _sync(device)
    secs_per_call = []
    for _ in range(WINDOWS):
        start = time.perf_counter()
        for _ in range(iters):
            call()
        _sync(device)
        secs_per_call.append((time.perf_counter() - start) / iters)
    sec = statistics.median(secs_per_call)
    out = {
        "path": name,
        "sec_per_call": round(sec, 6),
        "unit_per_call": unit_per_call,
        "windows_ms": [round(1e3 * s, 3) for s in secs_per_call],
        "model_gflops_per_call": round(flops / 1e9, 2) if flops else None,
        **mfu_report(flops, sec, device),
    }
    print(json.dumps(out), flush=True)
    return out


def bench_sampler(args, device) -> dict:
    from attngan_torch.core.config import GanConfig
    from attngan_torch.infer.sampler import InferState, Sampler

    cfg = GanConfig(gf_dim=args.gf_dim, df_dim=args.df_dim,
                    emb_dim=args.emb_dim, num_stages=args.num_stages,
                    compute_dtype=args.compute_dtype)
    batch = args.sampler_batch
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, VOCAB, (batch, cfg.seq_len)),
                             dtype=torch.int32, device=device)
    lengths = torch.full((batch,), cfg.seq_len, dtype=torch.int32,
                         device=device)

    def make(c):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            sampler = Sampler(InferState(c, VOCAB), device=device)
        gen = torch.Generator(device).manual_seed(SEED)
        return (lambda: sampler.generate_from_tokens(tokens, lengths,
                                                     generator=gen),
                [sampler.state])

    return report(f"sampler_b{batch}_{_tag(cfg)}", make, cfg,
                  f"one {batch}-image {cfg.resolutions[-1]}px sampling call",
                  args.iters or 20, device)


def bench_damsm(args, device) -> dict:
    from attngan_torch.core.config import DamsmConfig
    from attngan_torch.train.damsm_trainer import DamsmTrainer

    seq_len = 7
    cfg = DamsmConfig(emb_dim=args.emb_dim, image_encoder=args.image_encoder,
                      compute_dtype=args.compute_dtype)
    if args.damsm_batch:
        cfg = dataclasses.replace(cfg, batch_size=args.damsm_batch)
    b = cfg.batch_size
    rng = np.random.default_rng(SEED)
    batch = {
        "tokens": torch.as_tensor(rng.integers(0, VOCAB, (b, seq_len)),
                                  dtype=torch.int32, device=device),
        "lengths": torch.as_tensor(rng.integers(2, seq_len + 1, (b,)),
                                   dtype=torch.int32),
        "class_ids": torch.arange(b, device=device),
        "img256": torch.as_tensor(
            np.tanh(rng.standard_normal((b, 256, 256, 3))),
            dtype=torch.float32, device=device),
    }

    def make(c):
        trainer = DamsmTrainer(c, VOCAB, seq_len, device=device)
        state = trainer.init_state(seed=SEED)
        return lambda: trainer.train_step(state, batch), [state.rnn]

    return report(f"damsm_step_b{b}_{_tag(cfg)}", make, cfg,
                  f"one {b}-pair DAMSM train step (un-cached trunk)",
                  args.iters or 30, device)


def bench_gan(args, device) -> dict:
    from attngan_torch.core.config import GanConfig
    from attngan_torch.train.gan_trainer import GanTrainer

    cfg = GanConfig(gf_dim=args.gf_dim, df_dim=args.df_dim,
                    emb_dim=args.emb_dim, num_stages=args.num_stages,
                    image_encoder=args.image_encoder,
                    compute_dtype=args.compute_dtype)
    if args.gan_batch:
        cfg = dataclasses.replace(cfg, batch_size=args.gan_batch)
    b, seq_len = cfg.batch_size, cfg.seq_len
    rng = np.random.default_rng(SEED)
    batch = {
        "tokens": torch.as_tensor(rng.integers(0, VOCAB, (b, seq_len)),
                                  dtype=torch.int32, device=device),
        "lengths": torch.as_tensor(rng.integers(2, seq_len + 1, (b,)),
                                   dtype=torch.int32),
        "class_ids": torch.arange(b, device=device),
    }
    for res in cfg.resolutions:
        batch[f"img{res}"] = torch.as_tensor(
            np.tanh(rng.standard_normal((b, res, res, 3))),
            dtype=torch.float32, device=device)

    def make(c):
        trainer = GanTrainer(c, VOCAB, device=device)
        state = trainer.init_state(seed=SEED)
        return lambda: trainer.train_step(state, batch), [state.rnn]

    return report(f"gan_step_b{b}_{_tag(cfg)}", make, cfg,
                  f"one {b}-sample {cfg.num_stages}-stage GAN train step",
                  args.iters or 20, device)


def main(argv=None) -> list:
    from attngan_torch.core.runtime import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    bench = {"sampler": bench_sampler, "damsm": bench_damsm, "gan": bench_gan}
    return [bench[name](args, device) for name in PATHS if name in args.paths]


if __name__ == "__main__":
    main()
