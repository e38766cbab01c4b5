"""The check fails what it must, at a size a CPU test run holds: each
cell's control (the lower precision) and each fault a cell can have,
planted under the timed path, make ``correct`` false, while the sound
program passes the same limits. The harness's look for a chip is skipped
(the runs go through ``harness.run`` on the CPU). On the chip, at the
cells' own sizes, perfbench/limits.py reads the same variants."""

from __future__ import annotations

import pytest
import torch

from conftest import run_tiny, tiny

SERVE = ["lsun-serve-b64", "cub-serve-b1"]


@pytest.mark.parametrize("name", SERVE)
def test_sound_program_passes(name):
    cell, cfg = tiny(name, dtype="float32")
    assert run_tiny(name, cell, cfg)["correct"]


@pytest.mark.parametrize("name", SERVE)
def test_control_fails(name):
    cell, cfg = tiny(name)
    out = run_tiny(name, cell, cfg, variant="control")
    assert not out["correct"], out["compared"]


def _alter_one_image(monkeypatch):
    from attngan_torch.infer.sampler import Sampler

    real = Sampler.generate_stages

    def altered(self, *a, **k):
        images, attns = real(self, *a, **k)
        images[-1] = images[-1].clone()
        images[-1][0] = 1.0 - images[-1][0]
        return images, attns

    monkeypatch.setattr(Sampler, "generate_stages", altered)


def _leave_out_half(monkeypatch):
    from attngan_torch.infer.sampler import Sampler

    real = Sampler.generate_stages

    def half(self, tokens, lengths, noise=None, eps=None, *a, **k):
        h = len(tokens) // 2
        images, attns = real(self, tokens[:h], lengths[:h], noise[:h],
                             eps[:h], *a, **k)
        pad = [torch.cat([x, x[:len(tokens) - h]]) for x in images + attns]
        return pad[:len(images)], pad[len(images):]

    monkeypatch.setattr(Sampler, "generate_stages", half)


@pytest.mark.parametrize("fault", [_alter_one_image, _leave_out_half])
@pytest.mark.parametrize("name", SERVE)
def test_serving_faults_fail(name, fault, monkeypatch):
    cell, cfg = tiny(name, dtype="float32")
    fault(monkeypatch)
    assert not run_tiny(name, cell, cfg)["correct"]
