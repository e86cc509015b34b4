"""A run with the timed path broken underneath comes out not correct: the
harness's whole run (its look for a card skipped: device='cpu', the
tiny cells of tiny.py) with each fault a cell can have planted in the
port's entry point, and with the control (the reference computed with
float8 operands) in the program's place. The limits are the cells' own."""

import copy

import pytest
import torch

from portbench import common, run
from portbench.tests.tiny import tiny_cell


def tiny_run(name, driver=None):
    return run.run_cell(tiny_cell(name), 2 ** 31 + 99, 0.2, False,
                        device="cpu", driver_override=driver)


def altered(y):
    """An answer altered where it is produced: a 4x4 block at the centre
    of the first image (inside any tile's kept part) off by 0.5."""
    y = y.clone()
    h, w = y.shape[1] // 2, y.shape[2] // 2
    y[0, h - 2:h + 2, w - 2:w + 2] += 0.5
    return y


def test_esrgan_tail_altered(monkeypatch):
    from superresolution_tpu_torch.infer import phase_tail

    real = phase_tail.make_phase_tail
    monkeypatch.setattr(phase_tail, "make_phase_tail", lambda *a, **k: (
        lambda f, t=real(*a, **k): altered(t(f))))
    out = tiny_run("esrgan_x4.tiled_2k")
    assert not out["correct"], out["checks"]


def test_patch_output_altered(monkeypatch):
    from superresolution_tpu_torch.infer import fused_hat

    real = fused_hat.fused_hybrid_model
    monkeypatch.setattr(fused_hat, "fused_hybrid_model", lambda *a, **k: (
        lambda x, m=real(*a, **k): altered(m(x))))
    out = tiny_run("hybrid_astro.patch_b1")
    assert not out["correct"], out["checks"]


def test_upscale_output_altered(monkeypatch):
    from superresolution_tpu_torch import api

    real = api.upscale
    monkeypatch.setattr(api, "upscale", lambda *a, **k: altered(
        real(*a, **k)[None])[0])
    out = tiny_run("hybrid_astro.upscale_1k")
    assert not out["correct"], out["checks"]


def _planted_step(monkeypatch, fault):
    from superresolution_tpu_torch.train import trainer

    real = trainer.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def planted(state, batch, gen):
            if fault == "half_batch":  # the mean over the other half
                half = batch["lr"].shape[0] // 2
                return step(state, {k: v[:half] for k, v in batch.items()},
                            gen)
            # a step that returns its state unchanged
            params = {k: v.clone() for k, v in state.params.items()}
            opt = copy.deepcopy(state.opt_state)
            state, logs = step(state, batch, gen)
            for k, v in params.items():
                state.params[k].copy_(v)
            state.opt_state = opt
            return state, logs

        return planted

    monkeypatch.setattr(trainer, "make_train_step", make)


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged"])
def test_training_step_faults(monkeypatch, fault):
    _planted_step(monkeypatch, fault)
    out = tiny_run("hybrid_astro.train_b4")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["pairs_mismatched", "hr_scaled"])
def test_training_loader_faults(monkeypatch, fault):
    """The reference is fed the benchmark's own pairs, so a loader that
    decodes or pairs them wrong fails the step's numbers."""
    from superresolution_tpu_torch.data import loader

    real = loader.Loader._fetch

    def fetch(self, idxs):
        batch = real(self, idxs)
        if fault == "pairs_mismatched":
            batch["hr"] = batch["hr"][::-1].copy()
        else:  # a 16-bit image read at a wrong scale
            batch["hr"] = batch["hr"] * 0.5
        return batch

    monkeypatch.setattr(loader.Loader, "_fetch", fetch)
    out = tiny_run("hybrid_astro.train_b4")
    assert not out["correct"], out["checks"]


CELLS = ["esrgan_x4.tiled_2k", "hybrid_astro.patch_b1",
         "hybrid_astro.upscale_1k", "hybrid_astro.train_b4"]


@pytest.mark.parametrize("name", CELLS)
def test_fp8_control_reads_farther_than_the_program(name):
    """At a tiny size the control's gaps are a few times the program's
    (its full-size readings against the limits are the card test below)."""
    from portbench import calibrate

    cell = tiny_cell(name)
    r = calibrate.readings(cell, 2 ** 31 + 7, int(cell.get("sample", 1)),
                           True, device="cpu")
    assert any(r["control_fp8"][k] > 3 * r["program"][k]
               for k in cell["limits"]), r


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_controls_fail_a_limit_at_the_cells_size(name):
    """The control, on the card at the cell's own size, fails one of the
    cell's numbers, and so does a training step over half of its batch
    (three seeds are read by calibrate.py; one here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import calibrate

    cell = common.cell_files(name)
    r = calibrate.readings(cell, 2 ** 31 + 11, int(cell.get("sample", 1)),
                           True)
    for key in ("control_fp8", "fault_half_batch"):
        if key in r:
            assert any(r[key][k] > v for k, v in cell["limits"].items()), \
                (key, r)
