"""The port's spans and counters (superresolution_tpu_torch/utils/
profiling.py, data/loader.py) on the CPU: the recorder's bookkeeping,
the spans the hybrid, the tilers and the train step open, and the
loader's wait counters. Tiny shapes, no kernel build."""

import json
import threading
import time

import numpy as np
import pytest
import torch
import torch.nn as nn

from superresolution_tpu_torch.data.loader import Loader
from superresolution_tpu_torch.infer.fused_hat import fused_hybrid_model
from superresolution_tpu_torch.infer.tiled_device import (
    make_tiled_infer,
    make_tiled_infer_staged,
)
from superresolution_tpu_torch.models.hat_lite import HATLite
from superresolution_tpu_torch.models.hybrid import HybridSR
from superresolution_tpu_torch.models.rrdbnet import RRDBNet
from superresolution_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from superresolution_tpu_torch.train.steps import make_train_step
from superresolution_tpu_torch.utils.config import TrainConfig
from superresolution_tpu_torch.utils.precision import get_policy
from superresolution_tpu_torch.utils.profiling import record, span, trace


def tree(rec) -> list:
    """(name, parent's name or None, root's name) of each span, in the
    order they opened."""
    s = rec.spans
    return [(x.name, s[x.parent].name if x.parent >= 0 else None,
             s[x.root].name) for x in s]


def test_span_off_is_one_shared_null_context():
    a, b = span("a"), span("b")
    assert a is b
    with a:
        with b:
            pass
    with record() as rec:
        pass
    assert span("c") is a and rec.spans == []


def test_record_nests_spans_under_their_parents_and_roots():
    with record() as rec:
        with span("step"):
            with span("step.forward"):
                with span("step.forward.inner"):
                    pass
            with span("step.backward"):
                pass
        with span("next"):
            pass
    assert [(x.name, x.parent, x.root) for x in rec.spans] == [
        ("step", -1, 0), ("step.forward", 0, 0), ("step.forward.inner", 1, 0),
        ("step.backward", 0, 0), ("next", -1, 4)]
    s = rec.spans
    assert all(0 < x.start_ns <= x.end_ns for x in s)
    for x in s[1:4]:
        p = s[x.parent]
        assert p.start_ns <= x.start_ns <= x.end_ns <= p.end_ns
    assert s[1].end_ns <= s[3].start_ns and s[0].end_ns <= s[4].start_ns
    assert span("after") is span("again")  # uninstalled on exit


def test_record_refuses_a_second_recorder_and_closes_on_error():
    with record() as rec:
        with pytest.raises(RuntimeError, match="already installed"):
            with record():
                pass
        with pytest.raises(ValueError):
            with span("fails"):
                raise ValueError("inside")
        with span("then"):
            pass
    assert [(x.name, x.parent) for x in rec.spans] == [("fails", -1),
                                                        ("then", -1)]
    assert rec.spans[0].end_ns > 0


def test_a_span_on_another_thread_is_dropped():
    def other():
        with span("elsewhere"):
            pass

    with record() as rec:
        with span("main"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert [x.name for x in rec.spans] == ["main"]


def test_trace_writes_spans_on_the_trace_clock(tmp_path):
    """Each op falls in its spans once they are moved onto the trace's
    clock, with 50 ms to spare: a loaded host may run late between the
    marker's clock read and its start."""
    d = tmp_path / "tr"
    with trace(str(d)):
        with span("outer"):
            time.sleep(0.05)
            with span("inner"):
                time.sleep(0.05)
                torch.ones(64).sum()
                time.sleep(0.05)
            time.sleep(0.05)
            torch.ones(8).mul(2)
            time.sleep(0.05)
    events = json.loads((d / "trace.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in json.loads(
        (d / "spans.json").read_text())["traceEvents"]}
    assert set(spans) == {"outer", "inner"}
    assert spans["inner"]["args"]["parent"] == 0
    assert all(e["cat"] == "program_span" for e in spans.values())

    def within(op, name):
        ev = next(e for e in events if e.get("name") == op)
        s = spans[name]
        return s["ts"] <= ev["ts"] <= s["ts"] + s["dur"]

    assert within("aten::sum", "inner") and within("aten::mul", "outer")
    assert not within("aten::mul", "inner")


S1 = dict(scale=2, in_channels=1, out_channels=1, features=8, num_blocks=1,
          growth=4, upsampler="pixelshuffle")
HAT = dict(scale=2, in_channels=1, out_channels=1, embed_dim=12,
           depths=(2,), num_heads=(3,), window_size=4, upsample_feat=8)
HYBRID = [("hybrid", None, "hybrid"), ("hybrid.stage1", "hybrid", "hybrid"),
          ("hybrid.stage2", "hybrid", "hybrid")]


def _hybrid() -> HybridSR:
    torch.manual_seed(0)
    return HybridSR(RRDBNet(**S1, device="cpu"),
                    HATLite(**HAT, device="cpu"), output_size=32)


@pytest.mark.parametrize("form", ["fused", "module"])
def test_the_hybrid_opens_its_stage_spans(form):
    model = _hybrid()
    fn = (fused_hybrid_model(model.state_dict(), model, device="cpu")
          if form == "fused" else model)
    x = torch.rand(1, 8, 8, 1)
    with torch.no_grad(), record() as rec:
        out = fn(x)
    assert out.shape == (1, 32, 32, 1)
    assert tree(rec) == HYBRID


def _up2(t):
    return t.repeat_interleave(2, -3).repeat_interleave(2, -2)


def test_the_tiler_opens_gather_and_a_scatter_a_batch():
    def model(t):
        with span("model"):
            return _up2(t)

    run = make_tiled_infer(model, scale=2, tile=4, halo=1, batch=4, h=8,
                           w=12, channels=1, device="cpu")
    img = torch.rand(8, 12, 1)
    with record() as rec:
        out = run(img)
    assert torch.equal(out, _up2(img))
    # 6 tiles in batches of 4: two model calls, each followed by a scatter
    assert tree(rec) == [("tiler", None, "tiler"),
                         ("tiler.gather", "tiler", "tiler")] + [
        ("model", "tiler", "tiler"),
        ("tiler.scatter", "tiler", "tiler")] * 2


def test_the_staged_tiler_opens_gather_and_scatters_outside_the_model():
    def trunk(t):
        with span("trunk"):
            return t * 2.0

    def tail(f):
        with span("tail"):
            return _up2(f)

    # 6 tiles in tail chunks of 4: the last chunk is padded first
    run = make_tiled_infer_staged(trunk, tail, scale=2, tile=4, halo=1,
                                  tail_batch=4, h=8, w=12, channels=1,
                                  device="cpu")
    img = torch.rand(8, 12, 1)
    with record() as rec:
        out = run(img)
    assert torch.equal(out, 2.0 * _up2(img))
    root = ("tiler", None, "tiler")
    assert tree(rec) == [root] + [
        (n, "tiler", "tiler") for n in (
            "tiler.gather", "trunk", "tail", "tiler.scatter",
            "tiler.scatter", "tail", "tiler.scatter")]


class _Linear(nn.Module):
    """A per-pixel linear map of NHWC images (the upscale left out)."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(1, 1)

    def forward(self, x):
        return self.fc(x)


@pytest.mark.parametrize("accum", [1, 2])
def test_a_train_step_opens_step_forward_backward_and_optimizer(accum):
    torch.manual_seed(0)
    model = _Linear()
    tx, _ = make_optimizer(TrainConfig(), 10)
    state = create_train_state(
        {k: p.detach().clone() for k, p in model.named_parameters()}, tx)

    def loss_fn(pred, hr):
        loss = (pred - hr).abs().mean()
        return loss, {"total": loss}

    step = make_train_step(model, loss_fn, tx, get_policy("fp32"),
                           lambda b, g: (b["lr"], b["hr"]),
                           accum_steps=accum)
    batch = {"lr": torch.rand(2, 4, 4, 1), "hr": torch.rand(2, 4, 4, 1)}
    with record() as rec:
        state, logs = step(state, batch, None)
    assert state.step == 1 and torch.isfinite(logs["total"])
    root = "train.step"
    assert tree(rec) == [(root, None, root)] + [
        ("train.forward", root, root),
        ("train.backward", root, root)] * accum + [
        ("train.optimizer", root, root)]


class _Pairs:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.float32)}


def test_the_loader_counts_one_wait_a_batch():
    loader = Loader(_Pairs(), batch_size=2, shuffle=False, num_workers=2)
    assert (loader.wait_ns, loader.waits) == (0, 0)
    seen = []
    for i, batch in enumerate(loader):
        assert loader.waits == i + 1
        seen.append(batch["x"][:, 0].tolist())
    assert seen == [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9]]
    assert loader.wait_ns >= 0
    list(loader)
    assert loader.waits == 10
