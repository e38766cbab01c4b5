"""Rank processes for tests/test_torch_port_parallel.py.

``run_ranks(world, jobs)`` spawns ``world`` CPU processes joined by gloo
(``tcp://localhost``), runs the same jobs in each on a mesh of them, and
returns each rank's results: numpy trees, so that nothing but arrays
crosses the process boundary. Each job is also callable in the test's own
process with ``mesh=None``: the port in one process, on the whole batch.

This module imports torch and the port only (a spawned rank starts from a
fresh interpreter and does not need JAX).
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue as queue_module
import socket
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from attngan_torch.convert import load_damsm_flat, load_gan_flat
from attngan_torch.core.config import DamsmConfig, GanConfig
from attngan_torch.infer.sampler import InferState, Sampler
from attngan_torch.losses.damsm import damsm_loss
from attngan_torch.losses.damsm_sharded import make_sharded_damsm_loss
from attngan_torch.parallel import mesh as mesh_module
from attngan_torch.parallel.mesh import Mesh, shard_rows
from attngan_torch.train import damsm_trainer
from attngan_torch.train.checkpoint import state_parts
from attngan_torch.train.damsm_trainer import DamsmTrainer
from attngan_torch.train.gan_trainer import GanTrainer


def numpy_tree(tree):
    """Tensors -> numpy arrays, through dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(numpy_tree(v) for v in tree)
    return tree


def _rows(x: np.ndarray, mesh: Optional[Mesh]) -> np.ndarray:
    return shard_rows(x, mesh)


def _local_batch(batch: Dict[str, np.ndarray], mesh: Optional[Mesh]):
    return {k: _rows(v, mesh) for k, v in batch.items()}


# ---------------------------------------------------------------- the jobs

def loss_job(mesh: Optional[Mesh], inputs: Dict[str, np.ndarray],
             fused: bool = True) -> dict:
    """The DAMSM loss (sharded on a mesh) and its gradients in this rank's
    rows of img, code, words and sent."""
    local = {k: torch.from_numpy(_rows(v, mesh)) for k, v in inputs.items()}
    diff = {k: local[k].requires_grad_() for k in ("img", "code", "words",
                                                   "sent")}
    b = local["img"].shape[0]
    first = 0 if mesh is None else mesh.rank * b
    labels = torch.arange(first, first + b)
    args = (diff["img"], diff["code"], diff["words"], diff["sent"], labels,
            local["mask"], local["class_ids"])
    if mesh is None:
        total, parts, _ = damsm_loss(*args, fused=fused, attention_maps=False)
    else:
        total, parts = make_sharded_damsm_loss(mesh, fused=fused)(*args)
    total.backward()
    return numpy_tree({"total": total, **parts,
                       **{f"d_{k}": t.grad for k, t in diff.items()}})


def _damsm_faulty(fault: str):
    """Break the data-parallel gradient of the DAMSM step in this process:
    ``no_mean`` leaves the gradients unaveraged, ``clip_first`` clips the
    BiLSTM's by its local norm before the mean."""
    mean = mesh_module.all_reduce_mean_
    if fault == "no_mean":
        damsm_trainer.all_reduce_mean_ = lambda tensors, mesh: None
    elif fault == "clip_first":
        held: list = []
        damsm_trainer.all_reduce_mean_ = (
            lambda tensors, mesh: held.append((tensors, mesh)))
        foreach_mul = torch._foreach_mul_

        def clip_then_mean(grads, scale):
            foreach_mul(grads, scale)
            tensors, mesh = held.pop()
            mean(tensors, mesh)

        torch._foreach_mul_ = clip_then_mean
    else:
        raise ValueError(fault)


def damsm_job(mesh: Optional[Mesh], cfg: dict, vocab: int, seq_len: int,
              batches: Sequence[Dict[str, np.ndarray]], form: str = "plain",
              flat: Optional[dict] = None, fault: str = "") -> dict:
    """Steps of the DAMSM trainer on this rank's rows of each batch (a
    superbatch: of each of its K batches), from ``flat`` (a flattened JAX
    DamsmState) or from seed 1; its metrics and its state after them."""
    if fault:
        _damsm_faulty(fault)
    trainer = DamsmTrainer(DamsmConfig(**cfg), vocab, seq_len, device="cpu",
                           mesh=mesh)
    state = trainer.init_state(seed=1)
    if flat is not None:
        load_damsm_flat(flat, state)
    metrics = []
    if form == "super":
        k = trainer.cfg.superbatch
        groups = [batches[i:i + k] for i in range(0, len(batches), k)]
        for group in groups:
            local = [_local_batch(b, mesh) for b in group]
            batch = {key: np.concatenate([b[key] for b in local])
                     for key in local[0]}
            state, m = trainer.train_step_super(state, batch)
            metrics.extend({key: v[i] for key, v in m.items()}
                           for i in range(k))
    for batch in (batches if form != "super" else []):
        local = _local_batch(batch, mesh)
        if form == "cached":
            regions, pooled = trainer._eval_trunk_forward(
                state, torch.from_numpy(local["img256"]))
            local = {**local, "trunk_regions": regions,
                     "trunk_pooled": pooled}
            state, m = trainer.train_step_cached(state, local)
        else:
            state, m = trainer.train_step(state, local)
        metrics.append(m)
    return numpy_tree({"metrics": metrics, "state": state_parts(state)})


def gan_job(mesh: Optional[Mesh], cfg: dict, vocab: int,
            batch: Dict[str, np.ndarray], draws: Sequence[dict],
            flat: Optional[dict] = None) -> dict:
    """One GAN step per entry of ``draws`` (the global batch's noise, eps
    and real labels) on this rank's rows of ``batch``, from ``flat`` (a
    flattened JAX GanState) or from seed 1; its metrics and its state."""
    trainer = GanTrainer(GanConfig(**cfg), vocab, device="cpu", mesh=mesh)
    state = trainer.init_state(seed=1)
    if flat is not None:
        load_gan_flat(flat, state)
    local = _local_batch(batch, mesh)
    metrics = []
    for d in draws:
        d = {k: (None if v is None else
                 {r: torch.from_numpy(x) for r, x in v.items()}
                 if isinstance(v, dict) else torch.from_numpy(v))
             for k, v in d.items()}
        state, m = trainer.train_step(state, local, **d)
        metrics.append(m)
    return numpy_tree({"metrics": metrics, "state": state_parts(state)})


def sample_job(mesh: Optional[Mesh], cfg: dict, vocab: int,
               tokens: np.ndarray, lengths: np.ndarray, seed: int = 0,
               weights: Optional[dict] = None, noise=None, eps=None) -> dict:
    """Every stage's images and attention maps of the whole batch, sampled
    with this rank's share of it (an InferState of seed 1, or
    ``weights``); noise and eps drawn from ``seed`` where not given."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        state = InferState(GanConfig(**cfg), vocab)
    if weights is not None:
        state.load_state_dict({k: torch.from_numpy(v)
                               for k, v in weights.items()})
    sampler = Sampler(state, device="cpu", mesh=mesh)
    images, attns = sampler.generate_stages(
        tokens, lengths,
        noise=None if noise is None else torch.from_numpy(noise),
        eps=None if eps is None else torch.from_numpy(eps),
        generator=torch.Generator().manual_seed(seed))
    return numpy_tree({"images": images, "attns": attns})


def int8_job(mesh: Optional[Mesh], cfg: dict, vocab: int,
             tokens: np.ndarray, lengths: np.ndarray, weights: dict,
             noise: np.ndarray, eps: np.ndarray, img: np.ndarray) -> dict:
    """The int8 tier's calibration on this rank's rows: an Int8Sampler's
    p99 scales and its images of the whole batch, and the tiny trunk's
    max scales (DamsmTrainer.trunk_int8) over img."""
    from attngan_torch.infer.quantize import Int8Sampler

    state = InferState(GanConfig(**cfg), vocab)
    state.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    sampler = Int8Sampler(state, device="cpu", mesh=mesh)
    images = sampler.generate_from_tokens(tokens, lengths,
                                          torch.from_numpy(noise),
                                          torch.from_numpy(eps))
    trainer = DamsmTrainer(DamsmConfig(image_encoder="tiny", emb_dim=16,
                                       batch_size=img.shape[0],
                                       compute_dtype="", trunk_int8=True),
                           vocab, 4,
                           device="cpu", mesh=mesh)
    trunk = trainer._calibrate_trunk_int8(
        trainer.init_state(seed=0), torch.from_numpy(_rows(img, mesh)))
    return numpy_tree({"scales": sampler.act_scales, "trunk_scales": trunk,
                       "images": images})


JOBS = {"loss": loss_job, "damsm": damsm_job, "gan": gan_job,
        "sample": sample_job, "int8": int8_job}


# ------------------------------------------------------------- the ranks

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, jobs: list, results):
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
        out = []
        for job, shape, kwargs in jobs:
            mesh = Mesh(tuple(shape), rank, dist.group.WORLD)
            out.append(JOBS[job](mesh, **kwargs))
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))


def run_ranks(world: int, jobs: List[Tuple[str, tuple, dict]],
              timeout: float = 300.0) -> list:
    """Run ``jobs`` ((name, mesh shape, kwargs) each) in ``world`` spawned
    gloo ranks; returns [[each job's result] for each rank]."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, world, port, jobs, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                rank, out = results.get(timeout=1.0)
            except queue_module.Empty:
                dead = [p.exitcode for p in procs if p.exitcode]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"{world - len(got)} ranks gave no result (exit "
                        f"codes {dead}, {timeout} s allowed)") from None
                continue
            got[rank] = out
            if isinstance(out, str):
                break
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    for rank, out in got.items():
        if isinstance(out, str):
            raise RuntimeError(f"rank {rank} failed:\n{out}")
    return [got[rank] for rank in range(world)]
